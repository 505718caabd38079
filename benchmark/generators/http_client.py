"""The open-loop HTTP client of the serving cells: its own process, started
and ended by ``http_poisson.py``.

    python3 http_client.py --port P --traffic T.json --seed N --seconds S --out F

The schedule is the traffic file's: ``round(rate * seconds)`` arrivals
placed as one Poisson process with that many events in the window, and
``mix``'s kinds of request in their shares, both drawn from its
``arrival_seed``, so that every run offers the same arrivals of the same
kinds; each request goes on its own thread at its due time.  The run's
seed draws what the requests say: a prompt of ``words`` words from a
seeded vocabulary, a temperature from ``temperature`` = [low, high], a
sampling seed.  Each line written to
``--out`` is one request: its due, sent and done times (seconds from the
schedule's start, this process's clock), its HTTP status, its parameters
and the image it got back.  The client waits for every request until
``grace`` seconds past the window.
"""

import argparse
import http.client
import json
import sys
import threading
import time

import numpy as np


def schedule(traffic, seed, seconds):
    rng = np.random.default_rng(seed)
    n = max(1, int(round(traffic['rate'] * seconds)))
    fixed = np.random.default_rng(traffic['arrival_seed'])
    due = np.sort(fixed.uniform(0.0, seconds, n))
    kinds = []
    for i, m in enumerate(traffic['mix']):
        share = n - len(kinds) if i == len(traffic['mix']) - 1 else \
            int(round(m['share'] * n))
        kinds += [i] * max(0, min(share, n - len(kinds)))
    kinds = fixed.permutation(np.array(kinds))
    vocab = [''.join(rng.choice(list('abcdefghijklmnopqrstuvwxyz'),
                                int(rng.integers(3, 10))))
             for _ in range(traffic['vocabulary'])]
    lo, hi = traffic['words']
    tlo, thi = traffic['temperature']
    out = []
    for i in range(n):
        m = traffic['mix'][int(kinds[i])]
        words = rng.choice(vocab, int(rng.integers(lo, hi + 1)))
        out.append({'i': i, 'due': float(due[i]),
                    'body': {'prompt': ' '.join(words),
                             'timesteps': m['timesteps'], 'topk': m['topk'],
                             'guidance_scale': m['guidance_scale'],
                             'temperature': float(rng.uniform(tlo, thi)),
                             'seed': int(rng.integers(2 ** 31))}})
    return out


def post(port, body, rec, t0):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=300)
    try:
        payload = json.dumps(body).encode()
        rec['sent'] = time.perf_counter() - t0
        conn.request('POST', '/generate', payload,
                     {'Content-Type': 'application/json'})
        resp = conn.getresponse()
        data = resp.read()
        rec['done'] = time.perf_counter() - t0
        rec['status'] = resp.status
        if resp.status == 200:
            rec['image'] = json.loads(data)['image']
        else:
            rec['error'] = data[:500].decode('utf-8', 'replace')
    except (OSError, http.client.HTTPException, ValueError) as e:
        rec['status'] = -1
        rec['error'] = repr(e)
    finally:
        conn.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--port', type=int, required=True)
    ap.add_argument('--traffic', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--out', required=True)
    args = ap.parse_args()
    with open(args.traffic) as f:
        traffic = json.load(f)
    reqs = schedule(traffic, args.seed, args.seconds)
    recs = [dict(r) for r in reqs]
    threads = []
    t0 = time.perf_counter()
    for rec in recs:
        wait = rec['due'] - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        th = threading.Thread(target=post, args=(args.port, rec['body'], rec, t0),
                              daemon=True)
        th.start()
        threads.append(th)
    end = t0 + args.seconds + traffic['grace']
    for th in threads:
        th.join(max(0.0, end - time.perf_counter()))
    with open(args.out, 'w') as f:
        for rec in recs:
            rec.setdefault('status', 0)   # never answered
            f.write(json.dumps(rec) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
