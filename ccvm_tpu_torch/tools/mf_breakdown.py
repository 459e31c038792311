"""Where the MF kernel's time goes, on the card: ``tools/breakdown.py``'s MF
rows (MF and MF-Adam with noise, MF without noise, without its matvec and
with one x buffer).

Run from the root of a checkout on a machine with the card::

    python -m ccvm_tpu_torch.tools.mf_breakdown [--rounds 5]

which is ``python -m ccvm_tpu_torch.tools.breakdown --family mf``.
"""

from __future__ import annotations

import sys

from ccvm_tpu_torch.tools import breakdown


def main(argv=None):
    breakdown.main(["--family", "mf", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    main()
