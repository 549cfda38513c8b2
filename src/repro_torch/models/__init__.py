from . import softmax_reg
