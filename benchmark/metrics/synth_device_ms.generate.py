"""``synth_device_ms.generate``: device-busy milliseconds per Adam step of
one shard (2,048 seeds) in the traced call: the union of every device operation's
interval over the steps the shard log counts."""


def read(r):
    if r.unit != "step" or not r.ops:
        return None
    return 1e3 * r.busy_s / r.units
