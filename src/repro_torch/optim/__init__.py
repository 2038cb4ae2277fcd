from repro_torch.optim.adamw import (AdamWState, adamw_init,  # noqa: F401
                                     adamw_update, adamw_update_,
                                     clip_by_global_norm,
                                     cosine_schedule)
from repro_torch.optim.compression import (compress_int8,  # noqa: F401
                                           decompress_int8,
                                           ef_compress_update)
