from benchmark.reference.mstref.theory.scales import (  # noqa: F401
    KEY_NAMES,
    MAJOR,
    MINOR,
    ALL_MODES,
    Mode,
    Scale,
    MAJOR_PROFILE,
    MINOR_PROFILE,
    detect_scale,
    detect_scales_batch,
    scale_scores,
    keys_dist_from_notes,
)
from benchmark.reference.mstref.theory.degrees import (  # noqa: F401
    ACC_FLAT,
    ACC_NONE,
    ACC_SHARP,
    DegreeTables,
    degree_tables,
)
