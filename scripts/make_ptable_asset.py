#!/usr/bin/env python
"""One-time converter: reference probability table -> compact npz asset.

The reference ships 41,880 Monte-Carlo tuples ``(k, w, p, e1, e2)`` embedded
as a 1.7 MB Python literal (reference modules/p_minimizers_shared.py; generated
by scripts/compute_shared_minimizer_probabilities.py).  We carry the same
*data* as a compressed npz of typed arrays — loaded at startup by
ngspeciesid/utils/ptable.py.  The table can be regenerated from scratch
with scripts/generate_p_table.py (our own generator).

Usage: python scripts/make_ptable_asset.py [reference_table.py] [out.npz]
"""

import ast
import sys

import numpy as np

SRC = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/modules/p_minimizers_shared.py"
DST = sys.argv[2] if len(sys.argv) > 2 else "ngspeciesid/data/p_minimizers.npz"


def main():
    with open(SRC) as f:
        text = f.read()
    # The file is "L = [ ...tuples... ]\ndef read_empirical_p(): ..."; parse the
    # literal without executing any reference code.
    start = text.index("[")
    end = text.rindex("]") + 1
    tuples = ast.literal_eval(text[start:end])
    arr = np.array(tuples, dtype=np.float64)
    k = arr[:, 0].astype(np.int16)
    w = arr[:, 1].astype(np.int16)
    p = arr[:, 2]
    e1 = arr[:, 3]
    e2 = arr[:, 4]
    np.savez_compressed(DST, k=k, w=w, p=p, e1=e1, e2=e2)
    print(f"wrote {DST}: {len(tuples)} entries")


if __name__ == "__main__":
    main()
