"""The distributed layer of the port on ``torch.distributed``: the
('data', 'model') mesh and process groups (``mesh.py``), partition rules
and shard helpers (``sharding.py``), the collectives of dense tensor
parallelism over 'model' (``tensor.py``) and the pipelines' data- and
tensor-parallel wiring (``auto.py``). Counterpart of
``genrec_tpu/parallel``. The row-sharded lookups are ``ops/embedding.py``,
the context-parallel ring ``ops/ring_attention.py``, and the data- and
tensor-parallel step the Trainer's (``train/trainer.py``).
"""

from genrec_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from genrec_tpu_torch.parallel.sharding import (BATCH_SPEC, match_partition_rules,  # noqa: F401
                                                shard_batch, shard_params)
