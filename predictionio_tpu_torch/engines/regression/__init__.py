from predictionio_tpu_torch.engines.regression.engine import (
    DataSourceParams,
    MeanSquareError,
    PredictedResult,
    Query,
    RegressionAverageServing,
    RegressionDataSource,
    RegressionEngine,
    RidgeAlgorithm,
    VectorQuerySerializer,
)

__all__ = [
    "DataSourceParams",
    "MeanSquareError",
    "PredictedResult",
    "Query",
    "RegressionAverageServing",
    "RegressionDataSource",
    "RegressionEngine",
    "RidgeAlgorithm",
    "VectorQuerySerializer",
]
