from .generator import TpchGenerator, date_num  # noqa: F401
