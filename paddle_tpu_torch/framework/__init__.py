from . import unique_name  # noqa
from .backward import append_backward, calc_gradient, gradients  # noqa
from .core import (Block, Operator, Parameter, Program, Variable,  # noqa
                   VarType, convert_dtype, default_main_program,
                   default_startup_program, grad_var_name, program_guard,
                   switch_main_program, switch_startup_program)
from .executor import Executor  # noqa
from .scope import Scope, global_scope, scope_guard  # noqa
