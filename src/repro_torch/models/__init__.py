"""The LM stack of the port: every family of the reference (dense, moe,
ssm, hybrid, and the vision and audio stubs) at training
(``forward_train``) and serving (prefill and cached decode, with a float
or int8 KV cache)."""
from . import attention, config, layers, moe, ssm, transformer  # noqa: F401
