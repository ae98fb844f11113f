from repro_torch.models.model_zoo import (  # noqa: F401
    Model,
    decode_step,
    forward_train,
    init_decode_state,
    init_params,
    params_from_numpy,
    params_to_numpy,
    prefill,
)
