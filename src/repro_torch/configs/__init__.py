from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_configs)

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "list_configs"]
