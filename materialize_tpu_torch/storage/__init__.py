from .generator import AuctionGenerator, TpchGenerator, date_num  # noqa: F401
