from .base import BaseOCLoss, compute_results, flat_ctrl_eval
from .rds import DDPMLikeReferenceSDELoss, EIReferenceSDELoss, EMReferenceSDELoss
