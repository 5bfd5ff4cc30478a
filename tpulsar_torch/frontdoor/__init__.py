"""The front door — counterpart of tpulsar/frontdoor/: so far the
pluggable TicketQueue interface with its spool and in-memory backends
(queue.py) and the tenant claim policy (tenancy.py).  The sqlite
queue, the gateway, the client and the federation router are not
ported yet."""
