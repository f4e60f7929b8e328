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
    PairwiseDistanceModel,
    ParametricCurveModel,
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
    "PairwiseDistanceModel",
    "ParametricCurveModel",
    "PoissonErrorModel",
    "PolynomialForwardModel",
    "StudentTErrorModel",
]
