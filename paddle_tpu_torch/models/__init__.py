from . import resnet, transformer  # noqa
