"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0: the up/down projections live inside the (m|s)LSTM blocks
(pre-up-projection mLSTM, proj factor 2, per the paper).  Pure recurrent =>
``long_500k`` decode is supported (O(1)/token state).
"""
from repro_torch.configs.base import ArchConfig, MLSTM, SLSTM

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    # xLSTM[7:1]-style: predominantly mLSTM with sLSTM every 8th block
    block_pattern=(MLSTM, MLSTM, MLSTM, MLSTM, MLSTM, MLSTM, MLSTM, SLSTM),
    xlstm_proj_factor=2.0,
    source="arXiv:2405.04517",
)
