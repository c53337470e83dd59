// Host helper of the converter: simulated-annealing bit allocation.
//
// Copy of sim_anneal in exllamav2_tpu/native/native.cpp (the reference's
// ext_quant.cpp sim_anneal analog): the same std::mt19937_64 stream and the
// same arithmetic, so one seed picks the same options in both packages.
// Compiled with g++ for the host by exllamav2_tpu_torch/native.py into
// build/native/ and bound through ctypes; no device code.

#include <cstdint>
#include <cmath>
#include <random>

extern "C" {

void sim_anneal(int64_t num_slots, const int64_t* slot_offsets,
                const int64_t* costs, const float* errs,
                int64_t budget, int64_t iters, uint64_t seed,
                float temp_start, int64_t* choice /* in/out */)
{
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> uni(0.0, 1.0);

    int64_t cost = 0;
    for (int64_t i = 0; i < num_slots; i++)
        cost += costs[slot_offsets[i] + choice[i]];

    double temp = temp_start;
    for (int64_t it = 0; it < iters; it++) {
        temp *= 0.9997;
        int64_t i = (int64_t)(rng() % num_slots);
        int64_t opts = slot_offsets[i + 1] - slot_offsets[i];
        int64_t j = (int64_t)(rng() % opts);
        int64_t dc = costs[slot_offsets[i] + j]
                   - costs[slot_offsets[i] + choice[i]];
        double de = (double)errs[slot_offsets[i] + j]
                  - (double)errs[slot_offsets[i] + choice[i]];
        if (cost + dc > budget) continue;
        if (de <= 0.0 || uni(rng) < exp(-de / (temp > 1e-12 ? temp : 1e-12))) {
            choice[i] = j;
            cost += dc;
        }
    }

    // greedy top-up with the leftover budget (optimize.py:149-158)
    bool improved = true;
    while (improved) {
        improved = false;
        double best_r = 0.0;
        int64_t bi = -1, bj = -1, bdc = 0;
        for (int64_t i = 0; i < num_slots; i++) {
            int64_t opts = slot_offsets[i + 1] - slot_offsets[i];
            for (int64_t j = 0; j < opts; j++) {
                int64_t dc = costs[slot_offsets[i] + j]
                           - costs[slot_offsets[i] + choice[i]];
                double de = (double)errs[slot_offsets[i] + j]
                          - (double)errs[slot_offsets[i] + choice[i]];
                if (dc > 0 && de < 0 && cost + dc <= budget) {
                    double r = -de / (double)dc;
                    if (r > best_r) { best_r = r; bi = i; bj = j; bdc = dc; }
                }
            }
        }
        if (bi >= 0) {
            choice[bi] = bj;
            cost += bdc;
            improved = true;
        }
    }
}

}  // extern "C"
