from .base import Trainable, TrainConfig
from .langevin import LangevinSolver
from .oc import (CMCD, DDS, PIS, RDS, Bridge, GaussianReferenceCtrl, GMMReferenceCtrl,
                 TrainableDiff)
