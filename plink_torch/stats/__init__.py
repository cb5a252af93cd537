from .distributions import f_logsf, zstat_logp_2sided

__all__ = ["f_logsf", "zstat_logp_2sided"]
