from .losses import (
    bidirectional_kl_loss,
    cross_entropy_loss,
    dice_loss_fn,
    entropy_minimization_loss,
    kl_loss,
    l1_loss,
    l2_loss,
    multi_label_soft_margin_loss,
    partial_cross_entropy_loss,
    soft_label_cross_entropy_loss,
)
