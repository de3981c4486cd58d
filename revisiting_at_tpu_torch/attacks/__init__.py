from .apgd import ApgdResult, apgd_attack, start_noise

__all__ = ["ApgdResult", "apgd_attack", "start_noise"]
