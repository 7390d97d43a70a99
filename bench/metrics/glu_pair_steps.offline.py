"""Gate/up pair steps the megakernel staged per launch over the profiled
stretch: the program's counter ``mega.glu_pairs`` over its counter
``mega.glu_launches``, from its table of totals
(``repro_torch.obs.trace.totals``), which only the profiled stretch fills.
On the row-tiled walk a launch stages each live pair step once per 64-row
tile, so a 4,096-row call of a schedule with P live pairs reads 64 P.
None where the program keeps no such counters, or they hold no launch."""


def read(obs):
    try:
        from repro_torch.obs.trace import totals
    except ImportError:
        return None
    counters = totals().get("counters", {})
    launches = counters.get("mega.glu_launches")
    pairs = counters.get("mega.glu_pairs")
    if not launches or pairs is None:
        return None
    return float(pairs) / float(launches)
