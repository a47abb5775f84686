"""MusicGen-medium [arXiv:2306.05284; hf] — decoder-only over EnCodec
tokens; the EnCodec frontend is a stub (input_specs provides precomputed
frame embeddings). MHA (kv == heads)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048, head_dim=64, qkv_bias=False,
    modality="audio_stub", rope_theta=1e4,
)

def smoke():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab=64, head_dim=16,
                          attn_q_chunk=32, loss_chunk=64)
