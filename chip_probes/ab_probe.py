"""One tree's host paths of an event import and a train read: `console import` of
N ML-1M-shaped JSON lines into a fresh sqlite app, then the recommendation
data source's train read (sqlite find_frame + interactions) of them.

    python chip_probes/ab_probe.py TREE EVENTS.jsonl WORKDIR
"""
import json
import os
import shutil
import sys
import time

tree, events, work = sys.argv[1:4]
sys.path.insert(0, tree)
shutil.rmtree(work, ignore_errors=True)
os.makedirs(work)
os.environ["PIO_FS_BASEDIR"] = work
for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
    del os.environ[k]
from predictionio_tpu_torch.tools import console  # noqa: E402
import predictionio_tpu_torch  # noqa: E402

assert predictionio_tpu_torch.__file__.startswith(os.path.abspath(tree)), predictionio_tpu_torch.__file__
console.main(["app", "new", "A"])
t0 = time.perf_counter()
console.main(["import", "--app", "A", "--input", events])
import_s = time.perf_counter() - t0
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import Storage  # noqa: E402
from predictionio_tpu_torch.engines.recommendation.engine import (  # noqa: E402
    DataSourceParams, RecommendationDataSource)

ds = RecommendationDataSource(DataSourceParams(app_name="A", event_names=["rate"]))
reads = []
for _ in range(3):
    ctx = RuntimeContext(storage=Storage(), device="cpu")
    t0 = time.perf_counter()
    td = ds.read_training(ctx)
    reads.append(time.perf_counter() - t0)
print(json.dumps({"tree": tree, "import_s": import_s, "read_s": reads, "rows": len(td.rows)}),
      flush=True)
