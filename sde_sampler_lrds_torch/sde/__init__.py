from .linear import OU, VP
from ..utils.common import get_timesteps
