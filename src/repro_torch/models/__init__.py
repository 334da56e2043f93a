"""The dense decoder: parameters, layers, attention, model and sampler."""
