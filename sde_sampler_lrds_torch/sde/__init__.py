from .linear import OU, VP, PinnedBM
from ..utils.common import get_timesteps
