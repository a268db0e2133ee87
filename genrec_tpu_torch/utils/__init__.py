"""Cross-cutting utilities: logging, results CSVs, plotting, misc."""

from genrec_tpu_torch.utils.misc import ensure_dir, set_color, get_local_time  # noqa: F401
from genrec_tpu_torch.utils.csv_results import append_results_csv  # noqa: F401
