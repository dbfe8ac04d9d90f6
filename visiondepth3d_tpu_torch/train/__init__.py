from .trainer import Trainer, ssi_align, ssi_loss

__all__ = ["Trainer", "ssi_align", "ssi_loss"]
