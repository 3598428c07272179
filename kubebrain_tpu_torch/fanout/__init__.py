"""kubebrain_tpu_torch.fanout — block-batched watch fan-out on the card.

The layer between the sequencer and the subscriber queues: a persistent
device-resident watcher-spec table (:class:`WatcherTable`), the single
dispatch funnel (:func:`fanout_dispatch`), and the hub-facing matcher
(:class:`DeviceFanout`) with its byte-identical host oracle
(:func:`match_oracle`).

One call of the fan-out kernel K4 matches a whole sequencer drain block
(the contiguous revision block group commit hands ``Backend._drain``)
against the entire watcher population and returns delivery work sized
O(matched pairs) — never the [E, W] mask.
"""

from .dispatch import fanout_dispatch
from .matcher import DeviceFanout, match_oracle
from .table import WatcherTable

__all__ = ["DeviceFanout", "WatcherTable", "fanout_dispatch", "match_oracle"]
