from repro_torch.models.registry import (Model, build_model,  # noqa: F401
                                        init_weights, weight_structs)
