"""Qwen2-72B [arXiv:2407.10671; hf] — dense GQA decoder, QKV bias."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, head_dim=128, qkv_bias=True,
    rope_theta=1e6,
)

def smoke():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=256, head_dim=16,
                          attn_q_chunk=32, loss_chunk=64)
