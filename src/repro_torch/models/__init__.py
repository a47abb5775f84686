"""The LM stack of the port: the dense family at training
(``forward_train``) and serving (prefill and cached decode). Other
families and the int8 KV cache come with later slices of the port."""
from . import attention, config, layers, transformer  # noqa: F401
