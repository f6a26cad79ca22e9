"""train_tokens_per_s: batch x seq tokens of every step completed in the
window, over the window's seconds (closed by a synchronisation)."""


def read(rec):
    if rec.steps is None or rec.window_s <= 0:
        return None
    t = rec.traffic
    return rec.steps * t["batch"] * t["seq_len"] / rec.window_s
