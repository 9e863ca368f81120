"""``paddle_tpu_torch.layers`` — the user-facing layer DSL (the subset of
``paddle_tpu.layers`` the port runs so far)."""

from . import control_flow, io, math_ops, metric_op, nn, tensor  # noqa
from .control_flow import equal, increment  # noqa
from .io import data  # noqa
from .math_ops import scale  # noqa
from .metric_op import accuracy  # noqa
from .nn import (batch_norm, conv2d, cross_entropy, dropout,  # noqa
                 elementwise_add, elementwise_mod, elementwise_mul,
                 elementwise_sub, embedding, expand, fc, flash_attention,
                 flatten, fused_lm_head_ce, gather, layer_norm, matmul,
                 mean, pool2d, reduce_max, reduce_mean, reduce_min,
                 reduce_prod, reduce_sum, relu, reshape, ring_attention,
                 sigmoid, sigmoid_cross_entropy_with_logits, sign, slice,
                 softmax, softmax_with_cross_entropy, split, square,
                 square_error_cost, switch_moe_ffn, tanh, topk, transpose,
                 unsqueeze)
from .tensor import (assign, cast, concat, create_global_var,  # noqa
                     create_parameter, fill_constant, range)
