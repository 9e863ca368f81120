"""Op lowering registry population — importing this package registers
every op lowering the port has."""

from . import (attention_ops, compat_ops, conv_bn_ops,  # noqa
               fused_ops, math_ops, metrics_ops, misc_ops, moe_ops, nn_ops,
               optimizer_ops, reduce_ops, tensor_ops)
from ..framework.registry import registered_ops  # noqa
