from predictionio_tpu_torch.engines.similarproduct.engine import (
    ALSSimilarAlgorithm,
    ALSSimilarParams,
    DataSourceParams,
    ItemScore,
    LikeAlgorithm,
    PredictedResult,
    Query,
    SimilarModel,
    SimilarProductDataSource,
    SimilarProductEngine,
    SumScoreServing,
    TrainingData,
)

__all__ = [
    "ALSSimilarAlgorithm",
    "ALSSimilarParams",
    "DataSourceParams",
    "ItemScore",
    "LikeAlgorithm",
    "PredictedResult",
    "Query",
    "SimilarModel",
    "SimilarProductDataSource",
    "SimilarProductEngine",
    "SumScoreServing",
    "TrainingData",
]
