from mst_torch.models.style_transfer import StyleTransferModel  # noqa: F401
from mst_torch.models.encoders import (  # noqa: F401
    PitchedChannelsEncoder, UnpitchedChannelsEncoder, StyleEncoder,
    MelodyEncoder, PitchedRhythmEncoder, UnpitchedRhythmEncoder,
)
from mst_torch.models.song_info import SongInfoModel  # noqa: F401
from mst_torch.models.appliers import (  # noqa: F401
    PitchedStyleApplier, UnpitchedStyleApplier,
)
