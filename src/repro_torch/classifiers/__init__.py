from repro_torch.classifiers.backend import ClassifierBackend, HashBackend, get_backend  # noqa: F401
