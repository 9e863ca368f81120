"""Op lowering registry population — importing this package registers
every op lowering the port has."""

from . import (attention_ops, compat_ops, control_flow_ops,  # noqa
               conv_bn_ops, fused_ops, math_ops, metrics_ops, misc_ops,
               moe_ops, nn_ops, optimizer_ops, reduce_ops, rnn_ops,
               sequence_ops, structured_ops, tensor_ops)
from . import shape_rules  # noqa  (after every op type is registered)
from ..framework.registry import registered_ops  # noqa
