"""``python -m ksim_tpu_torch.jobs`` — run a fleet worker process.

Thin launcher around :func:`ksim_tpu_torch.jobs.fleet.main`.  Spawning the
worker as the *package* (not ``-m ksim_tpu_torch.jobs.fleet``) avoids the
runpy double-import warning: ``ksim_tpu_torch.jobs.__init__`` imports
``fleet``, so running the submodule as ``__main__`` would execute it a
second time under a different name.
"""

from __future__ import annotations

import sys

from ksim_tpu_torch.jobs.fleet import main

if __name__ == "__main__":
    sys.exit(main())
