"""Template gallery: scaffold a user engine from the port's engine families.

Counterpart of the JAX package's ``tools/template.py`` (``pio template
list/get``, reference tools/.../console/Template.scala:69-429, which
downloads from a GitHub gallery; here the gallery is the in-tree engine
families, copied into a user directory as a package the operator owns
and edits). The gallery lists the JAX package's templates in its order;
a family the port lacks (markov, itemsim, simrank, friendrec) is listed
as not ported, and ``scaffold`` refuses it with ``NotPortedTemplate``.

A scaffolded engine is a plain Python package:

    <dir>/
      <pkg>/__init__.py     re-exports the factory
      <pkg>/engine.py       the family's engine source, copied (user-editable)
      engine.json           a variant wired to <pkg>.<Factory>
      README.md             the train/deploy quick start

``python -m predictionio_tpu_torch.tools.console train|deploy`` run from
``<dir>`` import ``<pkg>`` off the working directory, so the scaffold
trains and deploys with no configuration. The engine.json skeletons are
the JAX package's, except where the port's engine needs another: the
e-commerce family's algorithm is ``ecomm`` with its ``app_name``, and the
Universal Recommender's params carry ``app_name``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from dataclasses import dataclass


class NotPortedTemplate(ValueError):
    """The template's engine family is not in the port yet."""


@dataclass(frozen=True)
class Template:
    name: str
    package: str  # source package under predictionio_tpu_torch.engines
    factory: str  # factory class re-exported by the engine module
    description: str
    default_params: dict  # engine.json skeleton (datasource/algorithms)
    ported: bool = True


def _app(**params) -> dict:
    return {"params": {"app_name": "MyApp", **params}}


TEMPLATES: dict[str, Template] = {
    t.name: t
    for t in [
        Template(
            "recommendation",
            "predictionio_tpu_torch.engines.recommendation",
            "RecommendationEngine",
            "ALS collaborative filtering (rate/buy events → top-N items)",
            {"datasource": _app(),
             "algorithms": [{"name": "als", "params": {
                 "rank": 10, "num_iterations": 20, "lambda_": 0.01}}]},
        ),
        Template(
            "similarproduct",
            "predictionio_tpu_torch.engines.similarproduct",
            "SimilarProductEngine",
            "item-to-item similarity from ALS embeddings (view/like events)",
            {"datasource": _app(), "algorithms": [{"name": "als", "params": {"rank": 10}}]},
        ),
        Template(
            "classification",
            "predictionio_tpu_torch.engines.classification",
            "ClassificationEngine",
            "entity-property classification (NB / logistic / random forest)",
            {"datasource": _app(label_attr="plan"),
             "algorithms": [{"name": "naive", "params": {"lambda_": 1.0}}]},
        ),
        Template(
            "ecommerce",
            "predictionio_tpu_torch.engines.ecommerce",
            "ECommerceEngine",
            "e-commerce recommendation with live business-rule filters",
            {"datasource": _app(),
             "algorithms": [{"name": "ecomm", "params": {"app_name": "MyApp", "rank": 10}}]},
        ),
        Template(
            "markov",
            "predictionio_tpu_torch.engines.markov",
            "MarkovEngine",
            "next-item prediction from event sequences (Markov chain)",
            {"datasource": _app(), "algorithms": [{"name": "markov", "params": {"top_n": 50}}]},
            ported=False,
        ),
        Template(
            "itemsim",
            "predictionio_tpu_torch.engines.itemsim",
            "ItemSimilarityEngine",
            "exact item-item cosine similarity (the DIMSUM workload)",
            {"datasource": _app(), "algorithms": [{"name": "dimsum", "params": {"top_n": 50}}]},
            ported=False,
        ),
        Template(
            "recommendation-file",
            "predictionio_tpu_torch.engines.recommendation",
            "FileRecommendationEngine",
            "recommendation with a custom FILE data source (DataSource SPI"
            " against a foreign store)",
            {"datasource": {"params": {"filepath": "ratings.dat"}},
             "algorithms": [{"name": "als", "params": {"rank": 10}}]},
        ),
        Template(
            "simrank",
            "predictionio_tpu_torch.engines.simrank",
            "SimRankEngine",
            "graph-structural friend recommendation (SimRank)",
            {"datasource": _app(), "algorithms": [{"name": "simrank", "params": {
                "iterations": 5, "decay": 0.8}}]},
            ported=False,
        ),
        Template(
            "friendrec",
            "predictionio_tpu_torch.engines.friendrec",
            "FriendRecommendationEngine",
            "keyword-profile similarity scoring (friend recommendation)",
            {"datasource": _app(), "algorithms": [{"name": "keyword_similarity", "params": {
                "sim_weight": 1.0, "threshold": 1.0}}]},
            ported=False,
        ),
        Template(
            "universal",
            "predictionio_tpu_torch.engines.universal",
            "UniversalRecommenderEngine",
            "Universal Recommender: multi-event CCO with LLR scoring",
            {"datasource": _app(), "algorithms": [{"name": "ur", "params": {
                "app_name": "MyApp", "indicators": ["purchase", "view"]}}]},
        ),
    ]
}


def list_templates() -> list[Template]:
    return list(TEMPLATES.values())


_PKG_RE = re.compile(r"^[a-z_][a-z0-9_]*$")


def scaffold(template_name: str, dest_dir: str, pkg_name: str | None = None) -> str:
    """Copy a gallery engine into `dest_dir` as package `pkg_name`
    (default ``my_<name>``); returns the destination directory. Refuses a
    family the port lacks (NotPortedTemplate), an unknown template or a
    bad package name (ValueError) and a destination that already holds a
    scaffold (FileExistsError: no silent overwrite)."""
    t = TEMPLATES.get(template_name)
    if t is None:
        raise ValueError(f"unknown template {template_name!r}; available: "
                         + ", ".join(sorted(TEMPLATES)))
    if not t.ported:
        raise NotPortedTemplate(f"template {template_name!r} is not ported yet")
    pkg_name = pkg_name or f"my_{template_name}"
    if not _PKG_RE.match(pkg_name):
        raise ValueError(f"package name {pkg_name!r} must be a lowercase identifier")
    dest_dir = os.path.abspath(dest_dir)
    pkg_dir = os.path.join(dest_dir, pkg_name)
    if os.path.exists(pkg_dir) or os.path.exists(os.path.join(dest_dir, "engine.json")):
        raise FileExistsError(f"{dest_dir} already contains a scaffold")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    src_dir = os.path.join(root, t.package.replace(".", os.sep))
    os.makedirs(pkg_dir)
    shutil.copy(os.path.join(src_dir, "engine.py"), os.path.join(pkg_dir, "engine.py"))
    with open(os.path.join(pkg_dir, "__init__.py"), "w") as f:
        f.write(f'"""Scaffolded from the {t.name} template — edit freely."""\n'
                f"from {pkg_name}.engine import {t.factory}\n\n"
                f'__all__ = ["{t.factory}"]\n')
    variant = {
        "id": pkg_name,
        "description": t.description,
        "engineFactory": f"{pkg_name}.{t.factory}",
        **json.loads(json.dumps(t.default_params)),
    }
    with open(os.path.join(dest_dir, "engine.json"), "w") as f:
        json.dump(variant, f, indent=2)
        f.write("\n")
    console = "python -m predictionio_tpu_torch.tools.console"
    with open(os.path.join(dest_dir, "README.md"), "w") as f:
        f.write(f"# {pkg_name}\n\nScaffolded from the `{t.name}` template "
                f"({t.description}).\n\n"
                "```sh\n"
                f"{console} app new MyApp            # once\n"
                "# ... send events to the event server ...\n"
                f"{console} train  --engine-json engine.json\n"
                f"{console} deploy --engine-json engine.json --port 8000\n"
                "```\n\n"
                f"Edit `{pkg_name}/engine.py` to customize the DASE pipeline; "
                "`engine.json` selects algorithms and parameters.\n")
    return dest_dir
