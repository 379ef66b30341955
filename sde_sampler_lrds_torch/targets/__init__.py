from .base import Target
from .checkerboard import Checkerboard
from .delta import Delta
from .gauss import (
    GMM,
    BracketTwoModes,
    Gauss,
    GaussFull,
    GMMFull,
    IsotropicGauss,
    ManyModes,
    TwoModes,
    TwoModesFull,
    gmm_params,
    log_prob_gaussian,
    log_prob_gaussian_full,
    mog_full_log_prob,
    mog_log_prob,
    score_gauss,
    score_gauss_full,
    score_mog,
    score_mog_full,
)
from .logistic_regression import LogisticRegression
from .phi_four import PhiFour
from .rings import Rings
