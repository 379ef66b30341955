from .linear import OU, VP, CosineVP, PinnedBM
from ..utils.common import get_timesteps
