from repro_torch.models.model_zoo import (  # noqa: F401
    Model,
    decode_step,
    init_decode_state,
    init_params,
    params_from_numpy,
    prefill,
)
