"""Qwen2-0.5B [arXiv:2407.10671; hf] — dense GQA, QKV bias, tied embeds."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151936, head_dim=64, qkv_bias=True,
    tie_embeddings=True, rope_theta=1e6,
)

def smoke():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=256, head_dim=16,
                          attn_q_chunk=32, loss_chunk=64)
