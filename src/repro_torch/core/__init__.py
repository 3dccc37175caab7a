"""The port's decision core: offload types, batched decisions, cost models
and the profiling predictors."""
