from .mlp import AngleEncoding, DenseNet, FourierMLP, TimeEmbed, gelu_tanh, load_flax_params
from .reparam import CancelDriftCtrl, ClippedCtrl, LerpCtrl, ScoreCtrl, remove_reference_ctrl
from .potentials import (BetterPotentialCtrl, DRLWrapper, EBMAnatomyTrick, GaussTiltedPotential,
                         GMMTiltedPotential)
from .mnist_ebm import MNISTEnergy, MNISTNet
from .mnist_unet import Unet
