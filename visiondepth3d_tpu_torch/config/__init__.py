from .presets import (BUILTIN_PRESETS, load_builtin, load_preset, params_from_dict,
                      params_to_dict, save_preset)

__all__ = ["BUILTIN_PRESETS", "load_builtin", "load_preset", "params_from_dict",
           "params_to_dict", "save_preset"]
