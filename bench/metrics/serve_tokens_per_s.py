"""serve_tokens_per_s: tokens delivered inside the window, over the
window's seconds."""


def read(rec):
    if rec.tokens is None or rec.window_s <= 0:
        return None
    return rec.tokens / rec.window_s
