from .base import Trainable, TrainConfig
from .oc import (CMCD, DDS, PIS, RDS, Bridge, GaussianReferenceCtrl, GMMReferenceCtrl,
                 TrainableDiff)
