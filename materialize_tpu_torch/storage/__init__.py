from .generator import AuctionGenerator, CounterGenerator, TpchGenerator, date_num  # noqa: F401
