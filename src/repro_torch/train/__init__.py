from .step import TrainCfg, make_train_step  # noqa: F401
