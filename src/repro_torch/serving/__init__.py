from repro_torch.serving.engine import (BrownoutPolicy, HedgePolicy, Request,
                                        RetryPolicy, ServingConfig,
                                        ServingEngine)

__all__ = ["BrownoutPolicy", "HedgePolicy", "Request", "RetryPolicy",
           "ServingConfig", "ServingEngine"]
