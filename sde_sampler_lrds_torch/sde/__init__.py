from .integrator import (EulerIntegrator, integrate_sde, interpolate_traj,
                         make_brownian_increments)
from .langevin import ControlledLangevinSDE, ControlledSDE, LangevinSDE
from .linear import OU, VP, ConstOU, CosineVP, PinnedBM, ScaledBM
from ..utils.common import get_timesteps
