"""``paddle_tpu_torch.layers`` — the user-facing layer DSL (the subset of
``paddle_tpu.layers`` the port runs so far)."""

from . import (control_flow, io, math_ops, metric_op, nn,  # noqa
               sequence, structured, tensor)
from .control_flow import (DynamicRNN, IfElse, Print, StaticRNN,  # noqa
                           Switch, While, array_length, array_read,
                           array_write, create_array, equal,
                           greater_equal, greater_than, increment,
                           is_empty, less_equal, less_than, not_equal)
from .io import data  # noqa
from .math_ops import scale  # noqa
from .metric_op import accuracy  # noqa
from .nn import (batch_norm, conv2d, cross_entropy, dropout,  # noqa
                 elementwise_add, elementwise_mod, elementwise_mul,
                 elementwise_sub, embedding, expand, fc, flash_attention,
                 flatten, fused_lm_head_ce, gather, layer_norm, log,
                 logical_and, logical_not, logical_or, logical_xor, matmul,
                 mean, pool2d, py_func, reduce_max, reduce_mean, reduce_min,
                 reduce_prod, reduce_sum, relu, reshape, ring_attention,
                 sigmoid, sigmoid_cross_entropy_with_logits, sign, slice,
                 softmax, softmax_with_cross_entropy, split, sqrt, square,
                 square_error_cost, squeeze, stack, switch_moe_ffn, tanh,
                 topk, transpose, unsqueeze)
from .sequence import (sequence_first_step, sequence_last_step,  # noqa
                       sequence_mask, sequence_pool)
from .structured import beam_search, beam_search_decode  # noqa
from .tensor import (assign, cast, concat, create_global_var,  # noqa
                     create_parameter, fill_constant,
                     fill_constant_batch_size_like, ones_like, range,
                     reverse, tensor_array_to_tensor, zeros)
