"""The whole period's share of the card's bf16 peak, in %: the model FLOPs
of the periods of the window (``work.py``'s unfused count) over the window's
seconds, over the published peak. None on a card the table lacks."""

from portbench.work import peaks


def read(run):
    pk = peaks(run.device_name)
    w = run.window
    if pk is None or not w["units"]:
        return None
    return 100.0 * w["units"] * w["unit_flops"] / w["seconds"] / pk[0]
