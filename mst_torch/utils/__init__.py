from mst_torch.utils.misc import (  # noqa: F401
    freeze, group_by, flatten, dict_map, iter_all_files, make_dirs,
    assert_dir,
)
from mst_torch.utils.math import normalize_dist, round_number  # noqa: F401
from mst_torch.utils.metrics import cross_entropy  # noqa: F401
from mst_torch.utils.data import list2df, save_to_csv  # noqa: F401
from mst_torch.utils.numpy import to_1d_array, as_1d_array, random_sample  # noqa: F401
