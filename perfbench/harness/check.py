"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests the window finished,
drawn from the seed, holding the one with the most served tokens and one
of each batch slot, is run through the float32 reference of the cell's
architecture (its module's ``forward_rows``; the configuration file's
``"reference"``) over each request's raw prompt (the reference pads it
itself), the tokens it was served and the precision its call served it
at.  At every served token the reference's best logit is compared with
the logit of the token served: the widest gap, over the sample, is the
number judged against its limit (``judge``).  A served token that the
reference ranks first has gap 0; rounding in the served precision moves
near-ties, by little.

The control (``control_rows``) puts the reference at the next precision
below each row's, weights one step down (int8 for full precision, int4
for int8, int2 for int4) and activations as served, in the program's
place: at each position of the same prompts and served tokens it serves
the token that the lower precision ranks first, and those rows go
through the same ``served_gaps`` and ``judge`` as the program's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

LOWER_WEIGHT_BITS = {16: 8, 0: 8, 8: 4, 4: 2}


def lower_precision(bits):
    """The control's precision for a row served at ``bits`` (an int:
    weight bits; a pair: weight and activation bits): weights one step
    down (full precision to int8, int8 to int4, int4 to int2),
    activations as served."""
    if isinstance(bits, (tuple, list)):
        return (LOWER_WEIGHT_BITS[bits[0]], bits[1])
    return LOWER_WEIGHT_BITS[bits]


def sample_rows(rows: Sequence[Dict], n: int, seed: int) -> List[Dict]:
    """``n`` of the served rows, drawn from ``seed``: the one with the most
    served tokens, then one row of each batch slot not yet held (a fault
    in some rows of every batch, as half of the batch left out, cannot
    hide from the sample), then others."""
    rows = [r for r in rows if len(r["tokens"])]
    if not rows:
        return []
    rng = np.random.default_rng(int(seed))
    pick = [max(range(len(rows)), key=lambda i: len(rows[i]["tokens"]))]
    by_slot: Dict[int, List[int]] = {}
    for i, r in enumerate(rows):
        by_slot.setdefault(r["slot"], []).append(i)
    for slot in sorted(by_slot):
        if len(pick) < n and slot != rows[pick[0]]["slot"]:
            pick.append(int(rng.choice(by_slot[slot])))
    rest = [i for i in range(len(rows)) if i not in pick]
    more = min(n - len(pick), len(rest))
    if more > 0:
        pick += [int(i) for i in rng.choice(rest, size=more, replace=False)]
    return [rows[i] for i in pick]


def _ref_rows(rows: Sequence[Dict]) -> List[Dict]:
    """The reference's rows: the prompt, the gap, the tokens fed back
    (the served tokens but the last, unless the row says otherwise) and
    the precision the row was served at."""
    return [dict(prompt=r["prompt"], gap=r["gap"],
                 fed=np.asarray(r.get("fed", r["tokens"][:-1])),
                 bits=r["bits"])
            for r in rows]


def served_gaps(arch_mod, params: Dict, model: Dict, s_max: int,
                rows: Sequence[Dict], device) -> List[np.ndarray]:
    """Per row, the gap of each served token below the best logit of the
    reference (``arch_mod.forward_rows``) at its position."""
    logits = arch_mod.forward_rows(params, model, s_max, _ref_rows(rows),
                                   device)
    out = []
    for lg, r in zip(logits, rows):
        tok = torch.as_tensor(np.asarray(r["tokens"]), dtype=torch.long,
                              device=lg.device)
        best = lg.max(-1).values
        out.append((best - lg[torch.arange(len(tok)), tok]).cpu().numpy())
    return out


def judge(gaps: Sequence[np.ndarray], limit: float) -> Dict:
    """The verdict on a checked sample's gaps: ``correct`` where there is
    a sample and its widest gap is within ``limit``; ``failed`` counts
    the rows beyond it."""
    worst = max((float(g.max()) for g in gaps), default=float("inf"))
    return dict(correct=bool(len(gaps)) and worst <= limit, worst=worst,
                failed=sum(int(g.max() > limit) for g in gaps),
                tokens=sum(len(g) for g in gaps))


def control_rows(arch_mod, params: Dict, model: Dict, s_max: int,
                 rows: Sequence[Dict], device) -> List[Dict]:
    """The rows the control serves: the same prompts, gaps, fed tokens
    and precisions, and at each position the token that the reference at
    the row's lower precision (``lower_precision``) ranks first."""
    rr = _ref_rows(rows)
    low = arch_mod.forward_rows(
        params, model, s_max,
        [dict(r, bits=lower_precision(r["bits"])) for r in rr], device)
    return [dict(r, tokens=lg.argmax(-1).cpu().numpy())
            for r, lg in zip(rr, low)]


def control_verdict(keep: Dict) -> Dict:
    """The control's verdict on the sample a run kept (``run_cell``'s
    ``keep``): its rows judged as the program's are, each at the
    precision it was served at."""
    args = (keep["arch_module"], keep["params"], keep["model"],
            keep["s_max"])
    rows = control_rows(*args, keep["sample"], keep["device"])
    return judge(served_gaps(*args, rows, keep["device"]), keep["limit"])
