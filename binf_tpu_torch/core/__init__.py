from binf_tpu_torch.core.density import Density, ValueDict, VariableSpec, as_value_dict
from binf_tpu_torch.core.modules import field, frozen_dataclass, replace, static_field

__all__ = [
    "Density",
    "ValueDict",
    "VariableSpec",
    "as_value_dict",
    "field",
    "frozen_dataclass",
    "replace",
    "static_field",
]
