from . import ctr, resnet, transformer  # noqa
from .ctr import build_ctr_train  # noqa
