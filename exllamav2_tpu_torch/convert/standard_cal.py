"""Standard calibration corpus for the conversion pipeline.

Copy of exllamav2_tpu/convert/standard_cal.py, byte for byte in the text:
the calibration rows are cut from it, so both packages calibrate on the
same tokens. (This package imports nothing of the JAX package.)

The reference ships a curated multi-domain calibration set (wiki text,
code, multilingual prose, technical writing — conversion/tokenize.py +
exllamav2/conversion/standard_cal_data/*.utf8) downloaded at convert
time. This environment has no network, so the standard mix is a bundled
original corpus spanning the same domains: English prose, dialogue,
technical/scientific writing, source code in several languages, markup /
structured data, multilingual text (Latin, Cyrillic, CJK, Arabic,
Devanagari scripts), and numerics. Calibrating on varied token
statistics keeps the Hessians representative; the converter additionally
appends uniform-noise rows (pipeline.calibration_rows noise_rows) for
out-of-distribution ids.

All text here is original filler written for this file — it exists for
its token statistics, not its meaning.
"""

STANDARD_CAL_TEXT = """\
The harbor lights flickered as the last ferry crossed the bay, and the
keeper wrote the date in a ledger that had held forty years of weather.
Morning would bring fog, she knew, because the gulls had gone quiet and
the air tasted of iron. In the town above the docks, bakers were already
feeding their ovens, and the smell of bread drifted down through narrow
streets that remembered older names.

"Did you check the manifest?" asked Toren, not looking up from the rope.
"Twice," said Ila. "Forty crates of salt, twelve of wool, and the box
the magistrate wants kept dry."
"Then we sail at first light. Tell the boy to sleep while he can."

A transformer layer applies self-attention followed by a feed-forward
network, each wrapped in a residual connection and normalization. The
attention mechanism computes similarity scores between query and key
vectors, scales them by the square root of the head dimension, and uses
the resulting distribution to mix value vectors. Quantization reduces
the precision of stored weights — for example to four bits per value
with a shared scale per group of 32 — trading a small accuracy loss for
large memory savings and higher arithmetic throughput.

The mitochondrion converts chemical energy from nutrients into ATP
through oxidative phosphorylation. Its inner membrane folds into
cristae, increasing surface area for the electron transport chain. In
1925, measurements of osmotic pressure suggested that cells regulate ion
balance actively, a hypothesis confirmed decades later by radioisotope
tracing experiments at 37 degrees Celsius and pH 7.4.

def quicksort(items):
    if len(items) <= 1:
        return items
    pivot = items[len(items) // 2]
    left = [x for x in items if x < pivot]
    mid = [x for x in items if x == pivot]
    right = [x for x in items if x > pivot]
    return quicksort(left) + mid + quicksort(right)

class RingBuffer:
    def __init__(self, capacity: int):
        self.data = [None] * capacity
        self.head = 0
        self.size = 0

    def push(self, value):
        idx = (self.head + self.size) % len(self.data)
        self.data[idx] = value
        if self.size < len(self.data):
            self.size += 1
        else:
            self.head = (self.head + 1) % len(self.data)

static int parse_header(const uint8_t *buf, size_t len, header_t *out) {
    if (len < sizeof(uint32_t) * 2) return -EINVAL;
    out->magic = le32toh(*(const uint32_t *)buf);
    out->length = le32toh(*(const uint32_t *)(buf + 4));
    if (out->magic != 0x4C4D3242) return -EBADMSG;
    return 0;
}

const fetchRetry = async (url, tries = 3) => {
  for (let i = 0; i < tries; i++) {
    try {
      const res = await fetch(url, { timeout: 5000 });
      if (res.ok) return await res.json();
    } catch (err) {
      if (i === tries - 1) throw err;
      await new Promise(r => setTimeout(r, 2 ** i * 100));
    }
  }
};

SELECT region, COUNT(*) AS orders, SUM(total) AS revenue
FROM sales WHERE shipped_at >= '2024-01-01'
GROUP BY region HAVING SUM(total) > 10000
ORDER BY revenue DESC LIMIT 20;

{"config": {"layers": 32, "hidden_size": 4096, "rope_theta": 10000.0,
 "dtype": "bfloat16", "tags": ["base", "chat"], "eos_token_id": 2}}

<article lang="en"><h1>Release notes</h1><ul><li>Fixed a race in the
scheduler when two jobs share a cache page.</li><li>Reduced startup
latency by 40%.</li></ul></article>

Le vieux pont traverse la rivière depuis trois siècles, et chaque pierre
porte la marque du tailleur qui l'a posée. Die Bibliothek öffnet um neun
Uhr, aber die Lesesäle bleiben bis Mitternacht beleuchtet. El mercado de
los jueves llena la plaza de voces, frutas y el olor del pan recién
hecho. A ponte velha resiste às cheias porque os seus arcos dividem a
força da água.

Старый маяк стоит на мысу уже двести лет, и его свет виден за тридцать
километров в ясную ночь. Каждую осень рыбаки чинят сети у причала.

図書館の窓から見える銀杏の木は、秋になると黄金色に染まる。司書は毎朝、
新聞を整理してから開館の準備を始める。长江流经十一个省份，最终在上海
汇入东海。每年春天，候鸟沿着河谷向北迁徙。도서관은 아침 아홉 시에 문을
열고, 학생들은 시험 기간마다 자리를 찾아 일찍 도착한다.

يقع المرصد القديم على قمة الجبل، حيث يراقب الفلكيون النجوم منذ قرون.
في كل صيف يجتمع الباحثون لتبادل ما رصدوه خلال العام. पुस्तकालय की
सबसे पुरानी पांडुलिपि नौ सौ साल पुरानी है, और उसे कांच के नीचे रखा गया है।

Il faut noter que η = 0.82 ± 0.03 under load, while the control run
measured 7.2e-4 J/(kg·K) at 293 K. Matrix A ∈ R^{4096×11008} multiplied
by x ∈ R^{11008} costs about 9.0e7 multiply-accumulates; at 275 TFLOP/s
that is 0.33 microseconds, but streaming 22 MB of int4 weights at
819 GB/s takes 27 microseconds — the operation is bandwidth-bound.
Prices rose 3.4% year over year; the index closed at 18,402.17 on
Friday, 2024-03-15, up 214 points. Call +1 (555) 013-7726 between
9:00 and 17:30 UTC+02:00.

From: build-bot@example.invalid
Subject: nightly 2024-06-02 — 3 failures, 1 flake
The integration suite failed on shards 4, 9, and 23. Shard 9 is the
known timeout in test_checkpoint_resume; shards 4 and 23 are new and
bisect to commit 8f31c09 "rewrite page eviction". Logs attached.

Q: Why does the decode loop pad the batch to a power of two?
A: The compiler caches one executable per shape. Padding coalesces
hundreds of possible batch sizes into a handful of buckets, so steady
state never recompiles, at the cost of a few wasted rows.
"""

__all__ = ["STANDARD_CAL_TEXT"]
