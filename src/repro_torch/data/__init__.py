from repro_torch.data.synthetic import (
    RegressionData,
    make_heterogeneous_regression,
    make_homogeneous_regression,
)

__all__ = [
    "RegressionData",
    "make_heterogeneous_regression",
    "make_homogeneous_regression",
]
