"""Qwen2.5-3B [hf:Qwen/Qwen2.5-3B; hf] — dense GQA, QKV bias."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab=151936, head_dim=128, qkv_bias=True,
    tie_embeddings=True, rope_theta=1e6,
)

def smoke():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=256, head_dim=16,
                          attn_q_chunk=32, loss_chunk=64)
