from .base import Target
from .gauss import (
    GMM,
    Gauss,
    GaussFull,
    IsotropicGauss,
    ManyModes,
    log_prob_gaussian,
    mog_log_prob,
    score_gauss,
    score_mog,
)
