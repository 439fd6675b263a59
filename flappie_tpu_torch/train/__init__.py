from .trainer import make_train_step, nll_loss, synthetic_batch
