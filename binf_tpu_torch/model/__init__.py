from binf_tpu_torch.model.error import (
    MOCK_DATA,
    BernoulliErrorModel,
    ErrorModel,
    GaussianErrorModel,
    LaplaceErrorModel,
    LogNormalErrorModel,
    PoissonErrorModel,
    StudentTErrorModel,
)
from binf_tpu_torch.model.forward import (
    ForwardModel,
    LinearForwardModel,
    PolynomialForwardModel,
)

__all__ = [
    "MOCK_DATA",
    "BernoulliErrorModel",
    "ErrorModel",
    "ForwardModel",
    "GaussianErrorModel",
    "LaplaceErrorModel",
    "LinearForwardModel",
    "LogNormalErrorModel",
    "PoissonErrorModel",
    "PolynomialForwardModel",
    "StudentTErrorModel",
]
