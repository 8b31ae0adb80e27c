"""Candidate rows kernel A's walk offers a row, over the pairs a row has
inside 2 h_i: the program's counter of candidates summed over the real rows
of every build (``sphax_torch.neighbors.window.CANDIDATES``, read once after
the window), its mean a row, over the final state's pairs inside 2 h_i a
row (``yardstick_2d.pair_counts``). None where the program keeps no such
counter or built no window structure (another engine ran)."""
from portbench import yardstick_2d


def read(run):
    from sphax_torch.neighbors import window

    sums = getattr(window, "CANDIDATES", {}).get("sums")
    if sums is None:
        return None
    cand, rows = (int(v) for v in sums.tolist())
    if not rows or not cand:
        return None
    pairs_a, _ = yardstick_2d.pairs(run)
    return (cand / rows) / (pairs_a / run.n)
