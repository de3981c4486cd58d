from .train_step import input_grad_view

__all__ = ["input_grad_view"]
