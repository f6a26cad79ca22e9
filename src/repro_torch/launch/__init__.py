"""Step builders of the port: the train step, and prefill and decode."""

from .steps import (make_decode_step, make_prefill_step,  # noqa: F401
                    make_train_step, value_and_grad)
