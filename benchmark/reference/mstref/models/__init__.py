from benchmark.reference.mstref.models.style_transfer import StyleTransferModel  # noqa: F401
from benchmark.reference.mstref.models.encoders import (  # noqa: F401
    PitchedChannelsEncoder, UnpitchedChannelsEncoder, StyleEncoder,
    MelodyEncoder, PitchedRhythmEncoder, UnpitchedRhythmEncoder,
)
from benchmark.reference.mstref.models.song_info import SongInfoModel  # noqa: F401
from benchmark.reference.mstref.models.appliers import (  # noqa: F401
    PitchedStyleApplier, UnpitchedStyleApplier,
)
