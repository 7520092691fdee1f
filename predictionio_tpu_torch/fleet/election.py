"""Compare-and-set leader election over the lifecycle record layer.

Counterpart of the JAX package's ``fleet/election.py``, with its record
entities and fields, so that candidates of either package bid in one
election. The scheduler's claim protocol (``deploy/scheduler.py``) made
general: every candidate appends a BID record carrying (generation,
claim token), and the winner is the FIRST bid of that generation in the
record layer's total event order, which every reader computes alike
once the bids are visible. No backend needs a CAS primitive.

- The **generation** is monotone and never reused (a claim bids the
  settled generation + 1), so it doubles as the replication *epoch*
  stamped into shipped WAL frames (``data/storage/replication.py``): a
  zombie primary still holding the old generation produces frames every
  follower refuses.
- The **claim token** tells a candidate's own bid from another's bid
  for the same generation, so a lost race is seen locally.

Standard library only: elections run inside storage daemons.
"""

from __future__ import annotations

import logging
import time
import uuid
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger(__name__)

ELECTION_ENTITY = "pio_election"
ELECTION_BID_ENTITY = "pio_election_bid"


@dataclass(frozen=True)
class ElectionState:
    """The settled view of one election group."""

    leader: Optional[str]
    generation: int
    claim_token: Optional[str]
    claimed_at: float


class CasElection:
    """Fenced leader election for one named group over a
    ``LifecycleRecordStore``::

        el = CasElection(records, group="events-primary")
        gen = el.claim("replica-a", settle_s=0.2)

    `claim` returns the won generation (the new epoch), or None when
    another candidate won the race or the settled generation moved on
    meanwhile. Leadership is advisory: fencing is the consumer's job
    (stamp the generation into every side effect, refuse older ones)."""

    def __init__(self, records, group: str, entity: str = ELECTION_ENTITY,
                 bid_entity: str = ELECTION_BID_ENTITY):
        self._records = records
        self.group = group
        self._entity = entity
        self._bid_entity = bid_entity

    def state(self) -> ElectionState:
        d = self._records.fold(self._entity, self.group).get(self.group, {})
        return ElectionState(
            leader=d.get("leader"),
            generation=int(d.get("generation", 0)),
            claim_token=d.get("claim_token"),
            claimed_at=float(d.get("claimed_at", 0.0)),
        )

    def claim(self, candidate: str, settle_s: float = 0.0,
              generation: Optional[int] = None) -> Optional[int]:
        """Bid for leadership; the won generation or None.

        The bid's generation is the settled one + 1 unless `generation`
        names one (a coordinator driving a given epoch). The settle
        window gives racing candidates time to land their bids before
        the resolution; the resolution needs no window to be right (the
        order is total), the window only makes it less likely that an
        earlier bid becomes visible after a winner's check."""
        cur = self.state()
        gen = int(generation) if generation is not None else cur.generation + 1
        if gen <= cur.generation:
            return None
        token = uuid.uuid4().hex
        self._records.append(self._bid_entity, self.group, {
            "generation": gen, "claim_token": token, "candidate": candidate,
            "bid_at": time.time()})
        if settle_s > 0:
            time.sleep(settle_s)
        winner = self._winning_bid(gen)
        if winner is None or winner.get("claim_token") != token:
            return None
        # the settled record may have moved past this generation while we
        # slept (a later election): announcing would roll the epoch back
        if self.state().generation >= gen:
            return None
        self._records.append(self._entity, self.group, {
            "leader": candidate, "generation": gen, "claim_token": token,
            "claimed_at": time.time()})
        return gen

    def _winning_bid(self, generation: int) -> Optional[dict]:
        """The first bid of `generation` in the record layer's total
        order: the scheduler's claim rule."""
        for ev in self._records.events(self._bid_entity, self.group):
            props = dict(ev.properties)
            if int(props.get("generation", -1)) == generation:
                return props
        return None

    def gc_bids(self) -> int:
        """Delete the bids at or below the settled generation (they can
        never win again); returns how many went."""
        settled = self.state().generation
        removed = 0
        for ev in self._records.events(self._bid_entity, self.group):
            if int(ev.properties.get("generation", 0)) <= settled and ev.event_id:
                self._records.discard(ev.event_id)
                removed += 1
        return removed
