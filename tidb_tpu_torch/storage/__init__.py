from .memkv import MemKV
from .tso import TSO
from .mvcc import MVCCStore, Lock, WriteRecord
from .txn import Txn, Storage, Snapshot
from .regions import RegionMap, Region
