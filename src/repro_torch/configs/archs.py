"""The 10 assigned architectures (exact pool configs) + the paper's own
GPT/Qwen models used in its evaluation (§5.1).

Each assigned arch also has its own thin module (qwen2_0_5b.py, ...) that
re-exports its config, per the required repo structure.
"""
from repro_torch.configs.base import ArchConfig, MoeConfig, SsmConfig, register

QWEN2_0_5B = register(ArchConfig(
    name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab_size=151936, head_dim=64,
    qkv_bias=True, mlp="swiglu", rope_theta=1e6, tie_embeddings=True,
    source="arXiv:2407.10671; hf"))

QWEN15_32B = register(ArchConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=27392, vocab_size=152064, head_dim=128,
    qkv_bias=True, mlp="swiglu", rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-0.5B; hf"))

LLAMA32_3B = register(ArchConfig(
    name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab_size=128256, head_dim=128,
    mlp="swiglu", rope_theta=5e5, tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B; unverified"))

H2O_DANUBE_18B = register(ArchConfig(
    name="h2o-danube-1.8b", family="dense", n_layers=24, d_model=2560,
    n_heads=32, n_kv_heads=8, d_ff=6912, vocab_size=32000, head_dim=80,
    mlp="swiglu", window=4096,  # llama+mistral mix with SWA
    source="arXiv:2401.16818; hf"))

INTERNVL2_1B = register(ArchConfig(
    name="internvl2-1b", family="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab_size=151655, head_dim=64,
    qkv_bias=True, mlp="swiglu", rope_theta=1e6, tie_embeddings=True,
    frontend="patches", frontend_tokens=256,  # InternViT STUB embeddings
    source="arXiv:2404.16821; hf"))

GROK1_314B = register(ArchConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=32768, vocab_size=131072, head_dim=128,
    mlp="geglu", moe=MoeConfig(n_experts=8, top_k=2),
    source="hf:xai-org/grok-1; unverified"))

LLAMA4_MAVERICK = register(ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab_size=202048, head_dim=128,
    mlp="swiglu", moe=MoeConfig(n_experts=128, top_k=1),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified"))

RWKV6_16B = register(ArchConfig(
    name="rwkv6-1.6b", family="rwkv", n_layers=24, d_model=2048,
    n_heads=0, n_kv_heads=0, d_ff=7168, vocab_size=65536, head_dim=64,
    pos="none", norm="layernorm",  # Finch: data-dependent decay
    source="arXiv:2404.05892; unverified"))

WHISPER_SMALL = register(ArchConfig(
    name="whisper-small", family="encdec", n_layers=12, enc_layers=12,
    d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=51865,
    head_dim=64, qkv_bias=True, mlp="gelu", norm="layernorm", pos="sinusoid",
    frontend="frames",  # conv frontend STUB embeddings
    source="arXiv:2212.04356; unverified"))

HYMBA_15B = register(ArchConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab_size=32001, head_dim=64,
    mlp="swiglu", window=1024, hybrid_full_attn=(0, 15, 31),
    ssm=SsmConfig(d_state=16, expand=1),  # parallel attn+mamba heads
    source="arXiv:2411.13676; hf"))

# ---- paper's own evaluation models (§5.1) --------------------------------

GPT_350M = register(ArchConfig(
    name="gpt-350m", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=51200, head_dim=64,
    qkv_bias=True, mlp="gelu", norm="layernorm", pos="learned",
    source="paper §5.1 (GPT-350M on Pile)"))

GPT_2_7B = register(ArchConfig(
    name="gpt-2.7b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=51200, head_dim=80,
    qkv_bias=True, mlp="gelu", norm="layernorm", pos="learned",
    source="paper §5.4 (GPT-2.7B)"))

GPT_6_7B = register(ArchConfig(
    name="gpt-6.7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=16384, vocab_size=51200, head_dim=128,
    qkv_bias=True, mlp="gelu", norm="layernorm", pos="learned",
    source="paper §5.4/5.5 (GPT-6.7B)"))

GPT_13B = register(ArchConfig(
    name="gpt-13b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=20480, vocab_size=51200, head_dim=128,
    qkv_bias=True, mlp="gelu", norm="layernorm", pos="learned",
    source="paper Table 3 (GPT-13B)"))

QWEN25_7B = register(ArchConfig(
    name="qwen2.5-7b", family="dense", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab_size=152064, head_dim=128,
    qkv_bias=True, mlp="swiglu", rope_theta=1e6,
    source="paper §5.1 (Qwen2.5-7B on Open-Web-Math)"))

ASSIGNED = [
    "qwen2-0.5b", "qwen1.5-32b", "llama3.2-3b", "h2o-danube-1.8b",
    "internvl2-1b", "grok-1-314b", "llama4-maverick-400b-a17b",
    "rwkv6-1.6b", "whisper-small", "hymba-1.5b",
]
