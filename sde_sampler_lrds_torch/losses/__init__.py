from .base import BaseOCLoss, compute_results, flat_ctrl_eval
from .cmcd import ControlledLangevinSDELoss
from .dds import ExponentialIntegratorSDELoss
from .dis import DiscreteTimeReversalLossEI, TimeReversalLoss
from .rds import DDPMLikeReferenceSDELoss, EIReferenceSDELoss, EMReferenceSDELoss
