"""Relax loops whose convergence flag and hop count stay on the card.

Port note: the reference runs each fixed point as one ``lax.while_loop``
inside one compiled executable, its ``changed`` flag and hop count on the
device. The port runs a chunk of hops back to back on the card, each hop's
``any(next < d)`` summed into a device count (``run_hops``), and never
reads the flag inside the chunk:

- an eager loop (``fixed_point``: the sweeps, the dense and sparse views)
  reads the count once a chunk of hops, one blocking sync a chunk instead
  of one a hop: ``HOP_CHUNK`` hops, or where the loop runs again and
  again (a sweep's blocks, the warm sparse view) as many as its previous
  run took (``chunk_for``), since the hops past the fixed point are wasted
  card time;
- a body dispatched through the executable cache runs a fixed budget of
  hops and returns ``hop_status`` (hops, converged) on the card, in the
  meta row the event already reads back; the host re-dispatches a body
  whose budget ran out with ``next_budget``'s, and commits nothing of it.

Relaxing again at the fixed point changes nothing, so hops past it are
exact, and the changed flags are monotone: once a hop changes nothing,
every later hop changes nothing. So the reference's ``while_loop`` count
(the changed hops, plus the hop that found nothing to change, at most the
loop's limit ``n``) is ``min(changed + 1, limit)`` whatever the chunk.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from openr_tpu_torch.ops import dispatch_accounting as da

# hops a chunk: a fat tree's fixed points take 5-7 hops, so one chunk
# usually holds the whole loop and the hop that finds it converged
HOP_CHUNK = 8


def chunk_for(last_hops: int) -> int:
    """The chunk an eager loop reads its count after, from the hop count
    its previous run took (its changed hops and the hop that found nothing
    to change): a run as long converges inside one chunk with no hop
    wasted past the fixed point. ``HOP_CHUNK`` before any run."""
    return last_hops if last_hops >= 2 else HOP_CHUNK


def run_hops(step: Callable[[torch.Tensor], torch.Tensor], d: torch.Tensor,
             hops: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``hops`` steps ``d <- step(d)`` with no host sync: ``(d, changed)``,
    ``changed`` the int32 device count of the hops that lowered some
    entry."""
    changed = torch.zeros((), dtype=torch.int32, device=d.device)
    for _ in range(hops):
        nxt = step(d)
        changed = changed + (nxt < d).any().to(torch.int32)
        d = nxt
    return d, changed


def fixed_point(step: Callable[[torch.Tensor], torch.Tensor], d: torch.Tensor,
                limit: int, chunk: int = HOP_CHUNK) -> Tuple[torch.Tensor, int]:
    """Iterate ``step`` to its fixed point or ``limit`` hops, reading the
    changed count once a chunk (one ``ops.blocking_syncs`` each). Returns
    ``(d, hops)``, ``hops`` the reference's ``while_loop`` count."""
    done = changed = 0
    while done < limit:
        c = min(chunk, limit - done)
        d, got = run_hops(step, d, c)
        done += c
        got = da.sync_count(got)
        changed += got
        if got < c:
            break
    return d, min(changed + 1, limit)


def hop_status(changed: torch.Tensor, budget: int, limit: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device ``(hops, converged)`` of a run of ``budget`` hops from
    ``run_hops``: ``hops`` the ``while_loop`` count, ``converged`` False
    when the budget ran out below ``limit`` with the last hop still
    changing (the caller then re-dispatches with a larger budget)."""
    hops = (changed + 1).clamp_max(limit)
    if budget >= limit:
        converged = torch.ones((), dtype=torch.bool, device=changed.device)
    else:
        converged = changed < budget
    return hops, converged


def next_budget(budget: int, limit: int) -> int:
    """The budget a re-dispatch runs after ``budget`` ran out."""
    return min(2 * budget, limit)
