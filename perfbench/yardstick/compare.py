"""The numbers that decide `correct`, each a gap between the program's
reading and the plain reference's, and the check of each against its
limit.

Training (the first steps of the one training state the window then
drives):
  loss_gap    the largest relative gap |program - reference| / |reference|
              over the first step's losses that do not read the alignment:
              the discriminator's, and the generator's adversarial,
              feature-matching, mel and sub-band terms. The duration and KL
              terms (and the total, their sum) read the hard MAS path, which
              a rounding-sized change in the log-likelihoods flips at
              near-ties, and later steps carry such a flip into every weight;
              grad_gap and change_gap cover those layers
  grad_gap    the worst leaf's gap between the program's and the
              reference's norms of the first gradient as each optimizer
              took it, over the larger of that leaf's reference norm and
              the median leaf's, over the leaves whose first gradient does
              not read the alignment: the discriminator's and the
              decoder's
  change_gap  the worst leaf's gap between the two norms of the change
              over the checked steps, over the larger of that leaf's
              reference change and the median leaf's; leaves whose first
              reference gradient is under a thousandth of the median
              leaf's are left out (they move by round-off alone)
  replay_loss_gap  as loss_gap, the worst over the first replays of the
              window's other signatures (each bucket's capture), the
              reference starting from the program's state copied before
              each: its weights and the discriminator's AdamW moments; 0
              where the cycle has one signature

Serving (a sample of the requests answered in the window):
  frames_off  the share of sampled requests whose frame count is not the
              reference's: the duration predictor's
  pcm_gap     the worst relative L2 distance between a sampled request's
              PCM and the reference's waveform on the int16 grid, over the
              requests of the reference's frame count
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Mapping, Sequence


ALIGNED = ("g/dur", "g/kl", "g/total")  # losses that read the MAS path
UNALIGNED_LEAVES = ("d.", "g.dec.")  # leaves whose first gradient does not


def term_gaps(prog: Mapping[str, float], ref: Mapping[str, float]
              ) -> Dict[str, float]:
    return {k: abs(prog[k] - r) / abs(r) for k, r in ref.items()
            if k in prog and abs(r) > 1e-12}


def loss_gap(program: Sequence[Mapping[str, float]],
             reference: Sequence[Mapping[str, float]]) -> float:
    gaps = term_gaps(program[0], reference[0])
    return max(v for k, v in gaps.items() if k not in ALIGNED)


def leaf_gap(program: Mapping[str, float], reference: Mapping[str, float],
             keep: Sequence[str] = None) -> float:
    names = [k for k in (keep if keep is not None else reference)
             if k in program]
    med = statistics.median(reference[k] for k in names)
    return max(abs(program[k] - reference[k]) / max(reference[k], med)
               for k in names)


def moving_leaves(first_grads: Mapping[str, float]) -> List[str]:
    """Leaves whose first reference gradient norm is at least a thousandth
    of the median leaf's."""
    med = statistics.median(first_grads.values())
    return [k for k, v in first_grads.items() if v >= 1e-3 * med]


def replay_loss_gap(program: Sequence[Mapping[str, float]],
                    reference: Sequence[Mapping[str, float]]) -> float:
    return max((loss_gap([p], [r]) for p, r in zip(program, reference)),
               default=0.0)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The training numbers; replay_loss_gap where the reference holds
    the replays."""
    out = {
        "loss_gap": loss_gap(prog["losses"], ref["losses"]),
        "grad_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"],
                             [k for k in ref["grad_norms"]
                              if k.startswith(UNALIGNED_LEAVES)]),
        "change_gap": leaf_gap(prog["change_norms"], ref["change_norms"],
                               moving_leaves(ref["grad_norms"])),
    }
    if "replays" in ref:
        out["replay_loss_gap"] = replay_loss_gap(prog["replays"],
                                                 ref["replays"])
    return out


def checks(numbers: Mapping[str, float], limits: Mapping[str, float]
           ) -> Dict[str, Dict[str, float]]:
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])}
            for k in limits}


def passed(checked: Mapping[str, Mapping[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())
