"""The paper's client models (App. A.1.1), as the reference's
``configs/paper_cnn.py`` registers them: ``kind="classifier"``,
``d_model`` doubles as the hidden width (the CNN's second conv's
channel count), ``d_ff`` is the fc width and ``vocab_size`` the number
of classes C."""
from repro_torch.configs.base import ModelConfig, register

CNN = register(ModelConfig(
    name="paper-cnn",
    kind="classifier",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=128,
    vocab_size=10,
    mlp="gelu",
    norm="layernorm",
    long_context_mode="skip",
    source="HiCS-FL App. A.1.1 (FMNIST CNN)",
))

MLP = register(ModelConfig(
    name="paper-mlp",
    kind="classifier",
    num_layers=2,
    d_model=128,
    num_heads=0,
    num_kv_heads=0,
    d_ff=128,
    vocab_size=10,
    mlp="gelu",
    norm="layernorm",
    long_context_mode="skip",
    source="HiCS-FL App. A.1.1 (MLP variant)",
))
