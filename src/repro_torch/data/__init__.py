from repro_torch.data.loader import LoaderState, ShardedLoader  # noqa: F401
from repro_torch.data.synthetic import (make_calibration_batch,  # noqa: F401
                                        synthetic_tokens)
