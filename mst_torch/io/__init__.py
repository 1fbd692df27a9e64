from mst_torch.io.smf import (  # noqa: F401
    EV_NOTE_OFF, EV_NOTE_ON, EV_POLYTOUCH, EV_CONTROL, EV_PROGRAM,
    EV_AFTERTOUCH, EV_PITCHWHEEL, EV_SYSEX, EV_TEMPO, EV_TIME_SIG,
    EV_KEY_SIG, EV_END_OF_TRACK, EV_META_OTHER,
    TrackEvents, MidiFileData, parse_midi_bytes, parse_midi_file,
    encode_midi, write_midi_file,
)
from mst_torch.io.midi import (  # noqa: F401
    DEFAULT_TEMPO, DEFAULT_VOLUME, MAX_VOLUME, MAX_VELOCITY,
    POPULAR_INSTRUMENTS, PROGRAM_TO_INSTRUMENT, PROGRAM_TO_GROUP,
    get_instrument_id, is_pitched, is_sound_effect,
    load_midi_from_file, create_midi,
    tempo2bpm, bpm2tempo, tick2second, second2tick,
)
