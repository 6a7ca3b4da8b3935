from repro_torch.configs.base import (MLAConfig, MoEConfig, ModelConfig,
                                      SSMConfig, get_config, reduced)

__all__ = ["MLAConfig", "MoEConfig", "ModelConfig", "SSMConfig",
           "get_config", "reduced"]
