from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    PAPER_ARCH_IDS,
    DeepSeekMoEConfig,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    ShapeConfig,
    all_configs,
    get_config,
    reduced,
)
from repro_torch.configs.gpt3_family import (
    GPT3_CONFIGS,
    GPT3_MOE_1_8B,
    PAPER_TABLE2,
    get_paper_config,
)

__all__ = [
    "ARCH_IDS", "INPUT_SHAPES", "PAPER_ARCH_IDS", "DeepSeekMoEConfig",
    "MLAConfig", "MoEConfig",
    "ModelConfig", "SSMConfig", "ShapeConfig", "all_configs", "get_config",
    "reduced", "GPT3_CONFIGS", "GPT3_MOE_1_8B", "PAPER_TABLE2",
    "get_paper_config",
]
