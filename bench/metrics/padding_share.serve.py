"""padding_share.serve: pad positions over all positions prefilled at
admission in the window: each prompt admitted is right-padded to
prefill_len."""


def read(rec):
    if not rec.admitted_lens:
        return None
    filled = len(rec.admitted_lens) * rec.traffic["prefill_len"]
    return 100.0 * (filled - sum(rec.admitted_lens)) / filled
