from .ks import compute_sliced_ks
from .metrics import get_metrics
from .mmd import mmd_median
from .sinkhorn import Sinkhorn
