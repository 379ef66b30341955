from .base import Trainable, TrainConfig
from .oc import RDS, GaussianReferenceCtrl, GMMReferenceCtrl, TrainableDiff
