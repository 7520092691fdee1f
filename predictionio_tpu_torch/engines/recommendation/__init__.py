from predictionio_tpu_torch.engines.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    DataSourceParams,
    FileDataSourceParams,
    FileRatingsDataSource,
    FileRecommendationEngine,
    ItemScore,
    PredictedResult,
    Query,
    RecommendationDataSource,
    RecommendationEngine,
    TrainingData,
)

__all__ = [
    "ALSAlgorithm",
    "ALSAlgorithmParams",
    "DataSourceParams",
    "FileDataSourceParams",
    "FileRatingsDataSource",
    "FileRecommendationEngine",
    "ItemScore",
    "PredictedResult",
    "Query",
    "RecommendationDataSource",
    "RecommendationEngine",
    "TrainingData",
]
