"""The reusable algorithm and evaluation library (reference
e2/src/main/scala/io/prediction/e2/): a copy of the JAX package's
``e2`` with the same exports. All of it is host code."""

from predictionio_tpu_torch.e2.naive_bayes import (
    CategoricalNaiveBayes,
    CategoricalNaiveBayesModel,
    LabeledPoint,
)
from predictionio_tpu_torch.e2.markov_chain import MarkovChain, MarkovChainModel
from predictionio_tpu_torch.e2.vectorizer import BinaryVectorizer
from predictionio_tpu_torch.e2.cross_validation import split_data

__all__ = [
    "BinaryVectorizer",
    "CategoricalNaiveBayes",
    "CategoricalNaiveBayesModel",
    "LabeledPoint",
    "MarkovChain",
    "MarkovChainModel",
    "split_data",
]
