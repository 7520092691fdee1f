"""FakeWorkflow: run an arbitrary function under the eval environment
without persisting anything.

Counterpart of the JAX package's ``workflow/fake.py`` (reference
core/src/main/scala/io/prediction/workflow/FakeWorkflow.scala:25-106): a
harness that runs a user function inside the evaluation machinery's
context (the storage, the device, the workflow params) with ``noSave``
semantics: no EvaluationInstance row and no model is written. The JAX
mesh becomes the device: ``run_fake_workflow(fn, device=...)`` hands
``fn`` a context whose ``device`` is the caller's (None: the entry
point's default, the first CUDA device).
"""

from __future__ import annotations

import json
import logging
from typing import Any, Callable, Optional

from predictionio_tpu_torch.core.base import RuntimeContext, WorkflowParams

log = logging.getLogger(__name__)


class FakeEvalResult:
    """Result wrapper with noSave semantics (FakeWorkflow.scala:37-44)."""

    no_save = True

    def __init__(self, value: Any):
        self.value = value

    def to_one_liner(self) -> str:
        return f"FakeEvalResult({self.value!r})"

    def to_html(self) -> str:
        return f"<pre>{self.to_one_liner()}</pre>"

    def to_json(self) -> str:
        try:
            return json.dumps({"value": self.value})
        except TypeError:
            return json.dumps({"value": repr(self.value)})


def run_fake_workflow(
    fn: Callable[[RuntimeContext], Any],
    storage: Any = None,
    device: Optional[str] = None,
    workflow_params: Optional[WorkflowParams] = None,
) -> FakeEvalResult:
    """Run `fn(ctx)` under an eval RuntimeContext and wrap its return
    value in a FakeEvalResult. Nothing is persisted (the reference's
    `FakeRunner` + noSave path); an exception of `fn` propagates."""
    ctx = RuntimeContext(storage=storage, mode="eval", device=device,
                         workflow_params=workflow_params or WorkflowParams())
    log.info("fake workflow: running %s", getattr(fn, "__name__", fn))
    return FakeEvalResult(fn(ctx))
