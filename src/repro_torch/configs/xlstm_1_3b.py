"""xLSTM-1.3B — sLSTM + mLSTM blocks (xLSTM[7:1] mix).

Copy of ``src/repro/configs/xlstm_1_3b.py``.
Source: [arXiv:2405.04517] (xLSTM). 48 blocks, d=2048, 4 heads. d_ff=0: the
blocks carry their own up/down projections (proj_factor). The mLSTM uses the
parallel/chunkwise matrix-memory form; the sLSTM is a true recurrent scan —
the same cell family as the reproduced paper's forecaster, and it shares the
fused-cell Pallas kernel lineage.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=8, mlstm_proj_factor=2.0,
                      slstm_proj_factor=1.3334, mlstm_head_dim=512,
                      chunk_size=256),
    source="arXiv:2405.04517",
)
