from .mlp import FourierMLP, TimeEmbed, gelu_tanh, load_flax_params
from .reparam import ClippedCtrl
