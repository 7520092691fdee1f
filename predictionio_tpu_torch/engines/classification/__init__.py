from predictionio_tpu_torch.engines.classification.engine import (
    ClassificationDataSource,
    ClassificationEngine,
    DataSourceParams,
    LogisticRegressionAlgorithm,
    NaiveBayesAlgorithm,
    PredictedResult,
    Query,
)

__all__ = [
    "ClassificationDataSource",
    "ClassificationEngine",
    "DataSourceParams",
    "LogisticRegressionAlgorithm",
    "NaiveBayesAlgorithm",
    "PredictedResult",
    "Query",
]
