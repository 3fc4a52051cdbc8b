"""AST-level invariant lint for the kueue-tpu stack's PyTorch/CUDA port.

The solver stack rests on a handful of invariants that, until this
package, were only enforced dynamically (a 2-hour soak failure instead
of a review-time error):

- **kernel purity** — the CUDA launchers, the functions that route to
  them and their plain twins must be pure functions of their tensors,
  with no device-to-host sync (``analysis.purity``);
- **dtype discipline** — packed planes carry declared dtypes; an
  accidental int64/float64 default on the transfer boundary defeats
  the tightening contract, and a launcher's argument check must ask
  for a plane's declared dtype (``analysis.dtypes``);
- **WAL ordering** — every store mutation in the driver is journaled
  first, and every ``wal.*`` chaos point sits between append and
  mutation (``analysis.wal_order``);
- **chaos-site registry** — documented, threaded and scenario-covered
  injection sites agree exactly (``analysis.chaos_sites``);
- **env-flag registry** — every ``KUEUE_TPU_*`` read goes through the
  ``features.ENV_FLAGS`` table and appears in the README flag table
  (``analysis.env_flags``);
- **metrics-doc registry** — every ``kueue_*`` series emitted into the
  metrics registry is declared in ``metrics._SERIES_DEFS`` and
  documented in the README metrics table, both directions
  (``analysis.metrics_doc``).

``python -m kueue_tpu_torch.analysis`` is the CLI; ``run_all`` is the
API.  Grandfathered findings live in ``baseline.json`` next to this
file, each with its reason — the baseline may only shrink
(tests/test_torch_analysis.py enforces both the
zero-unsuppressed-findings and the shrink-only invariant).  Everything
here is stdlib-``ast`` only: no torch, no numpy, no jax, so the lint
stays fast enough for tier-1.
"""

from .core import (  # noqa: F401
    BASELINE_PATH,
    DEFAULT_PATHS,
    Context,
    Finding,
    ParsedFile,
    all_passes,
    apply_baseline,
    load_baseline,
    run_all,
)
