"""Framework exceptions (parity: style/exceptions.py:1-4)."""


class MidiFormatError(Exception):
    """Raised when a MIDI file violates the format assumptions of the pipeline
    (mid-song time-signature/key changes, unknown message types, ...)."""


class MidiParseError(MidiFormatError):
    """Raised by the SMF codec on malformed bytes. Subclass of MidiFormatError so
    corpus iteration skips these files the same way the reference skips files that
    mido fails to load (style/midi.py:104-108, style/data.py:44-48)."""
