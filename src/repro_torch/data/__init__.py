from repro_torch.data.bonus import make_bonus_data, N_BONUS, TRUE_EFFECT
from repro_torch.data.dgp import make_irm_data, make_pliv_data, make_plr_data

__all__ = ["make_bonus_data", "N_BONUS", "TRUE_EFFECT", "make_irm_data",
           "make_pliv_data", "make_plr_data"]
