"""Architecture registry: ``get(name)`` -> ModelConfig, one module per arch
(shapes only; the port's copy of ``repro/configs``)."""

from importlib import import_module

ARCHS = (
    "xlstm_350m",
    "recurrentgemma_9b",
    "granite_moe_3b_a800m",
    "moonshot_v1_16b_a3b",
    "seamless_m4t_medium",
    "qwen3_14b",
    "h2o_danube_1_8b",
    "gemma_7b",
    "qwen2_5_32b",
    "phi_3_vision_4_2b",
)

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen2.5-32b": "qwen2_5_32b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
})


def get(name: str):
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ALIASES)}")
    return import_module(f"repro_torch.configs.{mod_name}").CONFIG


def all_names() -> tuple[str, ...]:
    return ARCHS
